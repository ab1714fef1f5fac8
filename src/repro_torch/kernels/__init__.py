"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions,
their launch geometries (``autotune``) and the dispatch face the
substrates call (``ops``).

Importing this package builds nothing: the CUDA library is compiled at
the first launch on a CUDA tensor (``_build.library``).
"""
