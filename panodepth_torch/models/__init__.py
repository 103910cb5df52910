"""The JAX package's nets in PyTorch: the perspective depth CNNs
(``NFPerspectiveNet``, the GN ``PerspectiveDepthNet``), the panoramic
baseline CNNs (``FastPanoNet``, the UniFuse-class ``PanoBaselineNet`` and
``NFPanoBaselineNet``, ``BiFuseNet``, ``HorizonDepthNet``, ``SliceNet``),
whose GroupNorms run the CUDA kernel ``csrc/groupnorm.cu``, and the loader
of the zoo's ``*.params.npz`` checkpoints (``weights``)."""
