"""Hardware constants of one NVIDIA H100 SXM (the port's counterpart of the
reference's ``launch/mesh.py``, which holds TPU v5e numbers).

Only the constants are here: the reference's ``make_*_mesh`` functions have
``repro_torch.core.mesh`` as their counterpart.  The rates are NVIDIA's
data sheet for the SXM part at its 700 W power limit, dense (no sparsity);
a card set to a lower limit runs slower under load.
"""

PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 on the tensor cores
PEAK_FLOPS_F32 = 67e12          # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12                # bytes/s, HBM3
ICI_BW = 450e9                  # bytes/s a direction, NVLink 4 (900 GB/s both)
