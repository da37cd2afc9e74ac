"""Hand-written CUDA kernels (the coloring hot loop, attention, ELL
aggregation), their wrappers and plain PyTorch versions.

``csrc/coloring.cu``   firstfit's entry (designs ``vec16`` / ``direct``) and
                       the ``direct`` design of firstfit and detect_recolor
                       (built by ``_build.py`` at first launch, with every
                       other ``csrc/*.cu``; shared helpers in
                       ``csrc/pass_common.cuh``)
``csrc/staged_pass.cuh``
                       the staged pass behind firstfit's and
                       detect_recolor's ``vec16`` and twohop's staged
                       designs
``csrc/detect_recolor.cu``
                       the fused detect-and-recolor entry (designs
                       ``vec16`` / ``direct``)
``csrc/twohop.cu``, ``csrc/twohop_staged.cu``
                       the fused two-hop (distance-2) kernel (designs
                       ``direct``; ``staged16`` / ``staged4``)
``firstfit.py``        wrapper + launch counters (round 0 of RSOC); the
                       shape rule both it and detect_recolor pick designs by
``detect_recolor.py``  wrapper + launch counter (every repair round; with
                       ``row_ids`` the compacted-frontier pass)
``twohop.py``          wrapper + launch counter (every distance-2 pass)
``csrc/flash_attention.cu``, ``flash_attention.py``
                       forward attention kernel + wrapper (serving prefill)
``csrc/ell_spmm.cu``, ``ell_spmm.py``
                       ELL neighbour-aggregation kernel + wrapper
                       (``ops.ell_aggregate``) + its gather floor
``ref.py``             the plain versions (CPU path and on-card oracle)
``ops.py``             dispatchers the engines call
``cost.py``            each kernel's work (phase 6's bounds, the dry run's
                       bill), ``on_card``, the hooks a cost counter listens on
"""
