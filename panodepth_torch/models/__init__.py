"""The JAX package's e2e nets in PyTorch: ``NFPerspectiveNet`` (the
perspective depth CNN) and ``FastPanoNet`` (the panoramic baseline CNN,
whose GroupNorms run the CUDA kernel ``csrc/groupnorm.cu``), with the loader
of the zoo's ``*.params.npz`` checkpoints (``weights``)."""
