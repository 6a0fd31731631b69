"""PyTorch/CUDA port of the rawhash_tpu raw-signal mapper.

The JAX package `rawhash_tpu` stays the reference.  This package runs the
same mapping engine, every mode and option of it (sharding over
torch.distributed included, `parallel/`), in PyTorch: plain tensor code for
every stage, and hand-written CUDA kernels (built from `csrc/` at first use)
where the reference used a Pallas kernel.  It keeps its own copies of the
reference's framework-free modules (options, pore models, index build and
files, signal readers, host chain tail, RMQ chaining, DTW, Sequence Until,
native C++ helpers) and imports neither jax nor `rawhash_tpu`.
"""
