from .math3d import (  # noqa: F401
    EPSILON,
    PI,
    SQRT_OF_ONE_THIRD,
    TWO_PI,
    build_transformation_matrix,
    inverse_transpose,
    normalize,
)
