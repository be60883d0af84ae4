"""zkp_subnet_tpu_torch — the KZG / Pianist prover ported to PyTorch + CUDA.

A second package beside the JAX reference ``zkp_subnet_tpu``: the same
module names (``ops/field.py``, ``ops/curve.py``, ``ops/poly.py``,
``ops/msm.py``, ``ops/ntt.py``, ``models/kzg.py``, ``models/srs.py``,
``models/pianist.py``, ``runtime/worker.py``), with tensors in place of jax
arrays and hand-written Hopper kernels (``csrc/``, built by
``ops/kernels.py``) in place of the Pallas ones. The package imports neither
JAX nor any file of the JAX package: the framework-free modules (the bigint
oracle, the wire codec, the native pairing loader, the protocol and config
dataclasses) are its own copies under ``utils/`` and ``runtime/``.
"""

__version__ = "0.1.0"
