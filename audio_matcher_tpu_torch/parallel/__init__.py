"""The resident scanners, the archive sweep and the device mesh of the port
(one or more query snippets, one device or several)."""

from .mesh import init_distributed, make_local_mesh, make_mesh

__all__ = ["init_distributed", "make_local_mesh", "make_mesh"]
