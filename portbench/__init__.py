"""portbench: the benchmark of fermi_tpu_torch (see run.py).

It imports nothing of the JAX package and measures the port alone; its
plain reference (reference/) imports nothing of the port either.
"""
