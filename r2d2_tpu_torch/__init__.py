"""PyTorch/CUDA port of the R2D2 learner, beside the JAX package it mirrors.

Module names follow the JAX package so each counterpart is easy to find.
The hand-written CUDA kernels live in ``csrc/`` and the host replay's C++
sum tree in ``native/``; both are built on first use (``ops/_build.py``)."""
