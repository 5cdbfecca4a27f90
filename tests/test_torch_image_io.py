"""The port's image I/O against the JAX package's and its libraries:
textures and env maps of any size resampled bit for bit as the JAX
loaders resample them (Pillow's BILINEAR, RGB and L), the Radiance
reader exactly OpenCV's decode (a run-length file OpenCV wrote, flat
files written here, the other orientations), `.hdr` env maps exactly the
JAX package's nearest-neighbour formula over that decode, and the PNG and
HDR writers (no Pillow, no imageio) read back exactly: the PNG by Pillow,
the HDR by OpenCV and by `read_hdr`, equal to the decode of the JAX
writer's file of the same image. Seconds in all."""

import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from project3_cuda_path_tracer_tpu.models import scene as jscene
from project3_cuda_path_tracer_tpu.utils import image as jimage
from project3_cuda_path_tracer_tpu_torch.models import scene as tscene
from project3_cuda_path_tracer_tpu_torch.utils import image as timage
from project3_cuda_path_tracer_tpu_torch.utils.resample import resize_bilinear

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(64, 64), (200, 300), (300, 200), (1024, 512)]  # (width, height)


def _picture(w, h, seed=0):
    """A smooth gradient with noise on half the pixels: both the filter's
    weights and its rounding are exercised."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     (x + y) * 255 // max(w + h - 2, 1)], -1)
    noise = rng.integers(0, 256, (h, w, 3))
    return np.where(rng.random((h, w, 1)) < 0.5, base, noise).astype(np.uint8)


@pytest.mark.parametrize("w,h", SIZES)
def test_textures_and_env_maps_resample_as_jax(tmp_path, w, h):
    path = str(tmp_path / f"tex_{w}x{h}.png")
    Image.fromarray(_picture(w, h, w + h), "RGB").save(path)
    for grey in (False, True):
        np.testing.assert_array_equal(tscene._load_texture(path, grey),
                                      jscene._load_texture(path, grey))
    np.testing.assert_array_equal(tscene._load_env_map(path),
                                  jscene._load_env_map(path))


@pytest.mark.parametrize("w,h,ow,oh", [(7, 5, 3, 11), (1, 1, 4, 2), (513, 3, 2, 9)])
def test_resize_equals_pillow_on_odd_sizes(w, h, ow, oh):
    """Up and down at once, a factor that is not an integer, one pixel."""
    img = _picture(w, h, 3)
    got = resize_bilinear(img, ow, oh)
    want = np.asarray(Image.fromarray(img, "RGB").resize((ow, oh), Image.BILINEAR))
    np.testing.assert_array_equal(got, want)
    got = resize_bilinear(img[..., 1], ow, oh)
    want = np.asarray(Image.fromarray(img[..., 1], "L").resize((ow, oh), Image.BILINEAR))
    np.testing.assert_array_equal(got, want)


def _radiance(h, w, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w, 3)).astype(np.float32)
    img *= rng.choice([0.0, 1e-4, 1.0, 40.0, 3e4], (h, w, 1)).astype(np.float32)
    img[0, 0] = 0.0
    return img


def _flat_file(path, rgbe, res_line):
    with open(path, "wb") as f:
        f.write(b"#?RGBE\nEXPOSURE=1.0\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(res_line + b"\n")
        f.write(np.ascontiguousarray(rgbe, np.uint8).tobytes())


def test_read_hdr_equals_opencv(tmp_path):
    cv2 = pytest.importorskip("cv2")
    img = _radiance(37, 300)
    rle = str(tmp_path / "rle.hdr")
    assert cv2.imwrite(rle, img[..., ::-1])  # OpenCV writes run-length lines
    want = cv2.imread(rle, cv2.IMREAD_UNCHANGED)[..., ::-1]
    np.testing.assert_array_equal(timage.read_hdr(rle), want)
    for w in (5, 9):  # flat: below the run-length width, and a first red byte of 3
        rgbe = timage.float_to_rgbe(_radiance(6, w, w))
        rgbe[:, 0, 0] = 3
        flat = str(tmp_path / f"flat{w}.hdr")
        _flat_file(flat, rgbe, f"-Y 6 +X {w}".encode())
        want = cv2.imread(flat, cv2.IMREAD_UNCHANGED)[..., ::-1]
        np.testing.assert_array_equal(timage.read_hdr(flat), want)
        np.testing.assert_array_equal(timage.read_hdr(flat), timage.rgbe_to_float(rgbe))


def test_read_hdr_orientations(tmp_path):
    """The other row-major resolution strings: bottom-up rows,
    right-to-left columns; a column-major one is refused."""
    rgbe = timage.float_to_rgbe(_radiance(4, 6, 1))
    want = timage.rgbe_to_float(rgbe)
    path = str(tmp_path / "o.hdr")
    for line, stored in ((b"+Y 4 +X 6", rgbe[::-1]), (b"-Y 4 -X 6", rgbe[:, ::-1]),
                         (b"+Y 4 -X 6", rgbe[::-1, ::-1])):
        _flat_file(path, stored, line)
        np.testing.assert_array_equal(timage.read_hdr(path), want, err_msg=line)
    _flat_file(path, rgbe.transpose(1, 0, 2), b"+X 6 -Y 4")
    with pytest.raises(ValueError, match="row-major"):
        timage.read_hdr(path)


def test_hdr_env_map_equals_jax_formula(tmp_path):
    """An .hdr env map: OpenCV's float decode, then the JAX loader's
    nearest-neighbour index formula (its imageio route reads 8 bits on
    this machine, so the formula is applied here to the float decode)."""
    cv2 = pytest.importorskip("cv2")
    for h, w in ((100, 300), (512, 1024)):
        path = str(tmp_path / f"sky{w}.hdr")
        assert cv2.imwrite(path, _radiance(h, w, h)[..., ::-1])
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1].astype(np.float32)
        ys = (np.arange(jscene.ENV_H) * img.shape[0] // jscene.ENV_H).clip(0, img.shape[0] - 1)
        xs = (np.arange(jscene.ENV_W) * img.shape[1] // jscene.ENV_W).clip(0, img.shape[1] - 1)
        np.testing.assert_array_equal(tscene._load_env_map(path), img[np.ix_(ys, xs)])
    with pytest.raises(ValueError, match="no EXR decoder|EXR decoder"):
        tscene._load_env_map(str(tmp_path / "sky.exr"))


def test_png_writer_read_back_by_pillow(tmp_path):
    for h, w in ((1, 1), (3, 7), (64, 33)):
        img = _picture(w, h, h * w)
        path = timage.save_png(str(tmp_path / f"p{h}x{w}"), img)
        assert path.endswith(".png")
        back = Image.open(path)
        assert back.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(back), img)


def test_hdr_writer_equals_jax_writer(tmp_path):
    cv2 = pytest.importorskip("cv2")
    for h, w in ((5, 3), (9, 8), (20, 300), (2, 129)):
        img = _radiance(h, w, w)
        mine = timage.save_hdr(str(tmp_path / f"t{w}"), img)
        theirs = jimage.save_hdr(str(tmp_path / f"j{w}"), img)
        want = cv2.imread(theirs, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(cv2.imread(mine, cv2.IMREAD_UNCHANGED), want)
        np.testing.assert_array_equal(timage.read_hdr(mine), want[..., ::-1])


def test_writers_import_neither_pillow_nor_imageio(tmp_path):
    code = (
        "import sys, numpy as np\n"
        "from project3_cuda_path_tracer_tpu_torch.utils import image\n"
        "from project3_cuda_path_tracer_tpu_torch.models import scene\n"
        f"d = {str(tmp_path)!r}\n"
        "image.save_png(d + '/a', np.zeros((4, 4, 3), np.uint8))\n"
        "image.save_hdr(d + '/a', np.ones((4, 9, 3), np.float32))\n"
        "image.read_hdr(d + '/a.hdr')\n"
        "scene._load_texture(d + '/a.png')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('PIL', 'imageio', 'cv2')]\n"
        "assert not bad, bad\n"
        "print('NO_IMAGING_OK')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "NO_IMAGING_OK" in proc.stdout
