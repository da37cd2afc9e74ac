"""``repro_torch`` — the PyTorch/CUDA port of the ``repro`` graph-coloring
package (Rokos et al., optimistic one-phase detect-and-recolor).

Same sub-package layout and names as the reference package; imports
``torch`` and ``numpy`` only.  The front door is ``repro_torch.api.color``.
"""
