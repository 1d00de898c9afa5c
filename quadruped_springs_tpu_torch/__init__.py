"""PyTorch + CUDA port of quadruped_springs_tpu (the JAX package stays the reference).

Each module keeps the path and public names of its JAX counterpart, so
``quadruped_springs_tpu_torch.models.dynamics`` ports
``quadruped_springs_tpu.models.dynamics``. Functions work on batch-first
tensors: a leading lane axis takes the place of ``vmap``. Hot elementwise
ops launch the hand-written CUDA kernels of ``csrc/planner_ops.cu`` when
their inputs lie on a CUDA device and run their plain PyTorch twins on the
CPU. The package imports torch and numpy, never jax.
"""
