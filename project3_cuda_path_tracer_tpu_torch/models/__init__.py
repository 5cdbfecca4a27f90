from .scene import (  # noqa: F401
    Camera,
    GeomsSoA,
    GeomType,
    MaterialsSoA,
    RenderState,
    Scene,
    load_scene,
)
