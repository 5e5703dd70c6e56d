"""The multi-process layer of the port: the TCPStore control plane
(control.py), the DCN data channel (dcn.py) and the cross-process
parameter manager (pm.py). The collective exchange and the mesh helpers
(the JAX package's collective.py and mesh.py) are ROADMAP queue A,
item 11b."""
