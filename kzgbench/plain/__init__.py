"""The benchmark's plain side: curves, transcript and the reference.

Imports neither ``jax``, the JAX package nor the program: each protocol's
``expected`` (``plain/<protocol>.py``) works out every answer from the
inputs and tau alone.
"""
