from . import camera, se3  # noqa: F401
