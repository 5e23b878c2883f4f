"""BVH traversal of the port: the scene's bin and preorder tables
(tables.py, numpy) and K3, the closest/any-hit kernels over them (ftb.py)."""
