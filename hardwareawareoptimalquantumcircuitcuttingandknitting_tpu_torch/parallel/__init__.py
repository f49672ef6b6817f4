"""Process-group meshes (mesh.py) and the sharded cut-circuit step
(sharded.py) over ``torch.distributed``."""
