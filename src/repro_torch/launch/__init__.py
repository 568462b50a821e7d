"""Launchers: device meshes (``launch.mesh``), the serving entry point
(``launch.serve``) and the fault-tolerant training launcher
(``launch.train``)."""
from .mesh import make_production_mesh, make_test_mesh, H100
