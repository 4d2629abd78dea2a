"""The plain reference that decides ``correct``: NumPy and PyTorch only.

It imports neither JAX nor anything of the program it judges. From a
job's two raw images and the benchmark's weights it works out the input
pyramids, the targets, the initial image and the job's first steps
again (``images``, ``model``, ``optim``).
"""
