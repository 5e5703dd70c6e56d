"""The multi-process layer of the port: the TCPStore control plane
(control.py), the DCN data channel (dcn.py), the cross-process
parameter manager (pm.py), the BSP collective exchange (collective.py,
over the receive slabs of exchange.py and K13) and the device placement
helpers (mesh.py)."""
from .mesh import MeshContext, get_mesh_context, make_mesh  # noqa: F401
