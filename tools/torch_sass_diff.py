"""Compare the SASS of every CUDA kernel of the PyTorch/CUDA port with
that of another checkout of this repository, kernel by kernel.

    python tools/torch_sass_diff.py --other DIR [--out FILE]

DIR is another checkout (or `git archive`) of the repository. Each
csrc/*.cu of both trees is compiled to a cubin with the port's own nvcc
flags (ops/_native.py, its own csrc/ on the include path), `cuobjdump
-sass` lists each function's instructions, and the two listings of each
kernel are compared as text. Functions are matched by name (demangled
where `cu++filt` is found), without their return type and parameters and
without a last template argument naming the plain tables type `Tables`:
the kernels that take the surface stage are templates on their tables,
so `full_iteration_kernel<Tables>` is compared with a tree's plain
`full_iteration_kernel`, and the instantiations on `TexTables` are
entries of their own. Prints one JSON line: per kernel "same", "differs"
(with both instruction counts) or the tree it is missing from; writes it
to FILE when given. Needs nvcc and cuobjdump (the CUDA toolkit), not a
GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_[0-9a-f]{8}")


def sass(tree: str, out_dir: str) -> dict:
    """{source: {function: [instructions]}} of the port's sources in `tree`."""
    from project3_cuda_path_tracer_tpu_torch.ops import _native

    csrc = os.path.join(tree, "project3_cuda_path_tracer_tpu_torch", "csrc")
    flags = [f for f in _native.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    nvcc = _native.find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    procs = {}
    for src in sorted(os.listdir(csrc)):
        if src.endswith(".cu"):
            cubin = os.path.join(out_dir, src + ".cubin")
            procs[src] = (cubin, subprocess.Popen(
                [nvcc, *flags, "-cubin", "-I", csrc, "-o", cubin, os.path.join(csrc, src)],
                stderr=subprocess.PIPE, text=True))
    out = {}
    for src, (cubin, p) in procs.items():
        _, err = p.communicate(timeout=900)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {src}: {err[-2000:]}")
        text = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True, text=True,
                              timeout=300, check=True).stdout
        funcs, name = {}, None
        for line in text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = m.group(1)
                funcs[name] = []
            elif name and re.search(r"/\*[0-9a-f]{4}\*/", line):
                # the instruction, without its offset and encoding comments
                # and the path hash of an anonymous namespace in a callee
                funcs[name].append(ANON.sub("_GLOBAL__N_", re.sub(r"/\*.*?\*/", "", line)).strip())
        out[src] = funcs
    return out


_TABLES_ARG = re.compile(r"(<|, )(?:<unnamed>|\(anonymous namespace\))::Tables>$")


def kernel_key(name: str) -> str:
    """A demangled function name without its return type, its parameters
    and a last template argument `Tables` (see the module docstring)."""
    name = re.sub(r"^void ", "", name)
    depth = 0
    for k, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:k]
            break
    return _TABLES_ARG.sub(lambda m: "" if m.group(1) == "<" else ">", name)


def demangle(names) -> dict:
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if not filt or not names:
        return {n: n for n in names}
    res = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True,
                         timeout=60)
    plain = res.stdout.splitlines()
    return dict(zip(names, plain)) if len(plain) == len(names) else {n: n for n in names}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="another checkout of the repository")
    ap.add_argument("--out", help="write the result here as JSON")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "this"))
        os.makedirs(os.path.join(tmp, "other"))
        this = sass(ROOT, os.path.join(tmp, "this"))
        other = sass(os.path.abspath(args.other), os.path.join(tmp, "other"))
    result = {}
    for src in sorted(set(this) | set(other)):
        # by demangled name: an anonymous namespace's mangled name carries a
        # hash of the file's path, which differs between the trees
        a, b = ({kernel_key(names[fn]): v for fn, v in tree.get(src, {}).items()}
                for tree, names in ((this, demangle([f for t in this.values() for f in t])),
                                    (other, demangle([f for t in other.values() for f in t]))))
        for fn in sorted(set(a) | set(b)):
            key = f"{src}:{fn}"
            if fn not in a or fn not in b:
                result[key] = "only in this tree" if fn in a else "only in the other tree"
            elif a[fn] == b[fn]:
                result[key] = "same"
            else:
                result[key] = f"differs ({len(b[fn])} -> {len(a[fn])} instructions)"
    line = json.dumps({"sass_vs_other": result})
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
