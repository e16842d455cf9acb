from . import camera, se3, sim3  # noqa: F401
