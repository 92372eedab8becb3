"""Parallelism: for now, the tensor-parallel decode roofline
(``roofline.py``) that bills the study's ``remote`` rows as an 8-GPU
NVLink node. Meshes, sharding and collectives are not ported yet."""
