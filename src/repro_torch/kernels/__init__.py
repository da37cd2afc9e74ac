"""Hand-written CUDA kernels of the coloring hot loop, their wrappers and
plain PyTorch versions.

``csrc/coloring.cu``   firstfit + detect_recolor (built by ``_build.py`` at
                       first launch, with ``csrc/twohop.cu``; shared helpers
                       in ``csrc/pass_common.cuh``)
``csrc/twohop.cu``     the fused two-hop (distance-2) kernel
``firstfit.py``        wrapper + launch counter (round 0 of RSOC)
``detect_recolor.py``  wrapper + launch counter (every repair round; with
                       ``row_ids`` the compacted-frontier pass)
``twohop.py``          wrapper + launch counter (every distance-2 pass)
``ref.py``             the plain versions (CPU path and on-card oracle)
``ops.py``             dispatchers the engines call
"""
