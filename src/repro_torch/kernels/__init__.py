"""Hand-written CUDA kernels of the coloring hot loop, their wrappers and
plain PyTorch versions.

``csrc/coloring.cu``   the kernels (built by ``_build.py`` at first launch)
``firstfit.py``        wrapper + launch counter (round 0 of RSOC)
``detect_recolor.py``  wrapper + launch counter (every repair round)
``ref.py``             the plain versions (CPU path and on-card oracle)
``ops.py``             dispatchers the engines call
"""
