"""Parallelism over processes (PyTorch port of
`diffusion_models_moe_tpu/parallel/`): `distributed.py` joins the process
group, `mesh.py` builds the ("dp", "tp") mesh, the sharding plans and the
tensor-parallel layers."""
