"""Hand-written CUDA kernels for Hopper (sources in ``repro_torch/csrc``).

Each module holds the kernel's wrapper (with its ``LAUNCHES`` counter),
the plain torch version of the same function, and a note on what bounds
the kernel on the card.  ``build.load_library`` compiles the sources with
``nvcc`` at first use.
"""
