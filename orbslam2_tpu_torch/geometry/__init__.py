from . import camera, se3, sim3, triangulation  # noqa: F401
