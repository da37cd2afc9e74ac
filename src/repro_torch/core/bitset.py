"""Packed-bitset forbidden sets + branch-free mex (DESIGN.md §10), in torch.

Every coloring engine runs the same hot loop: gather neighbor colors ->
forbidden set -> smallest free color (mex).  The dense representation
materializes the forbidden set as a (rows, C) uint8 table and takes the
first zero over the color axis — C compare lanes and C bytes per row.  This
module packs the same set into ``(rows, ceil(C/32))`` int32 words (bit b of
word w == color 32*w + b forbidden): 32× fewer compare lanes in the pack, 8×
less memory per retained row, and a branch-free mex built from two classic
bit tricks:

  * isolate the lowest ZERO bit of a word:  ``lz = ~w & (w + 1)``
    (power of two when w has a zero, 0 when w is all-ones), and
  * bit-index via the float-exponent trick: a power of two, converted to
    float32 (exact), carries its bit index in the IEEE-754 exponent field:
    ``(bits >> 23) - 127``.

The per-word candidate ``32*word + bit_index`` (full words get the sentinel
C) is minimized across words — word k's candidates all precede word k+1's,
so the min IS the first zero bit.  On total overflow (every bit set) the
result is ``mex=0, ovf=True``, mirroring the dense first-zero search over
an all-ones row, so the two implementations stay bit-identical even on rows
the caller will retry at a doubled cap.

Color caps that are not multiples of 32 are handled by pre-forbidding the
tail bits (>= C) of the last word, so mex never returns an out-of-cap color
and the overflow test is simply "every word is all-ones".

All helpers are plain torch on int32 tensors and are the *plain version* of
the arithmetic the CUDA kernels in ``repro_torch.kernels`` do in registers.
int32 wraparound is load-bearing (``w + 1`` on 0x7FFFFFFF, ``1 << 31``):
every operand stays an int32 tensor, never a Python int.
"""
from __future__ import annotations

import torch

WORD = 32  # bits per packed word

# implementations understood by every engine's ``forbidden_impl`` switch:
# "bitset" is the production path, "dense" the differential oracle.
IMPLS = ("bitset", "dense")


def n_words(C: int) -> int:
    """Packed words per row for a cap of C colors (ceil division)."""
    return -(-int(C) // WORD)


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def tail_mask(C: int, device=None) -> torch.Tensor:
    """(1, n_words) int32 with every bit for colors >= C set.

    OR-ing this into a packed row pre-forbids the out-of-cap tail, making
    mex/overflow exact for caps that are not multiples of 32.
    """
    nW = n_words(C)
    base = _iota(nW, device)[None, :] * WORD
    live = torch.clamp(C - base, 0, WORD)          # valid bits per word
    one = torch.ones((), dtype=torch.int32, device=device)
    # the shift count is clamped so a full word never shifts by 32 (its
    # value is replaced by -1 anyway)
    ones = torch.where(live == WORD, -one,
                       (one << torch.clamp(live, max=WORD - 1)) - 1)
    return ~ones


def _bit_of(nc: torch.Tensor, C: int):
    """(word index or -1, single-bit int32 word or 0) for a tensor of
    colors; colors outside [0, C) contribute nothing."""
    ok = (nc >= 0) & (nc < C)
    one = torch.ones((), dtype=torch.int32, device=nc.device)
    w_idx = torch.where(ok, nc >> 5, -one)
    bit = torch.where(ok, one << (nc & 31), one - 1)
    return w_idx, bit


def _or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise-OR reduction along ``dim`` (torch has no such reduction:
    fold the axis in halves, log2(size) elementwise ORs)."""
    x = x.movedim(dim, -1)
    size = x.shape[-1]
    if size == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    while size > 1:
        half = size // 2
        head = x[..., :half] | x[..., half:2 * half]
        x = torch.cat([head, x[..., 2 * half:size]], dim=-1) \
            if size % 2 else head
        size = x.shape[-1]
    return x[..., 0]


def pack_from_nbrc(nbrc: torch.Tensor, C: int) -> torch.Tensor:
    """Inline pack: (rows, W) neighbor colors -> (rows, n_words) bitset.

    A color c lands as bit ``c & 31`` of word ``c >> 5``; slots outside
    [0, C) (FILL = -1, overflowed colors) contribute nothing.  Tail bits
    >= C come back pre-forbidden (see ``tail_mask``).
    """
    nW = n_words(C)
    w_idx, bit = _bit_of(nbrc, C)                             # (rows, W)
    word_iota = _iota(nW, nbrc.device)[None, None, :]
    hit = w_idx[:, :, None] == word_iota                      # (rows, W, nW)
    contrib = torch.where(hit, bit[:, :, None],
                          torch.zeros((), dtype=torch.int32,
                                      device=nbrc.device))
    return _or_reduce(contrib, 1) | tail_mask(C, nbrc.device)


def or_color(forb: torch.Tensor, nc: torch.Tensor, C: int) -> torch.Tensor:
    """OR one column of neighbor colors (rows,) into a packed (rows, nW)
    table — the per-neighbor step of the inline pack."""
    nW = forb.shape[1]
    w_idx, bit = _bit_of(nc, C)
    word_iota = _iota(nW, forb.device)[None, :]
    return forb | torch.where(w_idx[:, None] == word_iota, bit[:, None],
                              torch.zeros((), dtype=torch.int32,
                                          device=forb.device))


def init_words(rows: int, C: int, device=None) -> torch.Tensor:
    """All-free packed table with the out-of-cap tail pre-forbidden."""
    return (torch.zeros((rows, n_words(C)), dtype=torch.int32, device=device)
            | tail_mask(C, device))


def pack_dense(forb_dense: torch.Tensor, C: int) -> torch.Tensor:
    """Pack a dense (rows, C) 0/1 table into (rows, n_words) int32 words.

    This is the scatter-then-pack route used for COO snapshot tables: COO
    edges scatter into a transient dense table (torch's scatters have no
    bitwise-or mode), which is packed once per pass — the *retained*
    snapshot the chunk loop slices every round is the 8×-smaller packed
    form.  The ELL gather path never needs the dense intermediate.
    """
    rows = forb_dense.shape[0]
    nW = n_words(C)
    device = forb_dense.device
    padded = torch.zeros((rows, nW * WORD), dtype=forb_dense.dtype,
                         device=device)
    padded[:, :C] = forb_dense[:, :C]
    lanes = padded.reshape(rows, nW, WORD)
    one = torch.ones((), dtype=torch.int32, device=device)
    shifts = _iota(WORD, device)[None, None, :]
    words = _or_reduce(torch.where(lanes > 0, one << shifts, one - 1), 2)
    return words | tail_mask(C, device)


def mex_words(words: torch.Tensor, C: int):
    """Branch-free mex over packed rows.  Returns (mex (rows,), ovf (rows,)).

    Per word: isolate the lowest zero bit (``~w & (w+1)``), recover its index
    through the float-exponent trick, form the candidate ``32*word + index``
    (sentinel C for all-ones words), and take the row minimum — bit-identical
    to a first-zero search over the dense table, including the overflow
    convention (an all-ones row gives ``mex=0, ovf=True``).
    """
    rows, nW = words.shape
    device = words.device
    full = words == -1
    lz = ~words & (words + 1)                     # lowest zero bit, isolated
    # unsigned view of the int32 word (bit 31 -> 2**31, not -2**31), then an
    # exact float32: every nonzero lz is a power of two
    f = (lz.to(torch.int64) & 0xFFFFFFFF).to(torch.float32)
    bidx = (f.view(torch.int32) >> 23) - 127
    base = _iota(nW, device)[None, :] * WORD
    cand = torch.where(full, torch.full((), int(C), dtype=torch.int32,
                                        device=device), base + bidx)
    if nW == 0:
        mex = torch.full((rows,), int(C), dtype=torch.int32, device=device)
    else:
        mex = cand.amin(dim=-1).to(torch.int32)
    ovf = mex >= C
    return torch.where(ovf, torch.zeros_like(mex), mex), ovf


def apply_recolor(work: torch.Tensor, mex: torch.Tensor, ovf: torch.Tensor,
                  c_r: torch.Tensor):
    """Recolor-commit tail shared by every detect-and-recolor path: rows in
    ``work`` take their mex, the rest keep ``c_r``; overflow only counts on
    rows that actually recolored.  Returns (newc, recolored, ovf&work)."""
    return torch.where(work, mex, c_r), work, ovf & work


def recolor_epilogue(forb: torch.Tensor, defect: torch.Tensor,
                     U: torch.Tensor, c_r: torch.Tensor, C: int):
    """Fused kernel epilogue: work mask + branch-free mex evaluated on the
    packed words — in the CUDA kernels while they are still in registers, so
    the forbidden table never reaches device memory.

    Returns (new colors (rows,), recolored (rows,) bool, overflow (rows,)
    bool) — overflow is only raised on rows that actually recolored.
    """
    work = U & defect
    mex, ovf = mex_words(forb, C)
    return apply_recolor(work, mex, ovf, c_r)


def to_dense(words: torch.Tensor, C: int) -> torch.Tensor:
    """Unpack (rows, n_words) -> (rows, C) uint8."""
    rows, nW = words.shape
    shifts = _iota(WORD, words.device)[None, None, :]
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(rows, nW * WORD)[:, :C].to(torch.uint8)


def ws_bytes(rows: int, C: int, impl: str = "bitset") -> int:
    """Retained forbidden-table working set in bytes for ``rows`` rows.

    dense: one uint8 lane per color; bitset: one int32 word per 32 colors —
    an 8× ratio at word-aligned C (DESIGN.md §10).
    """
    if impl == "dense":
        return rows * int(C)
    if impl == "bitset":
        return rows * n_words(C) * 4
    raise ValueError(f"unknown forbidden impl {impl!r}; known: {IMPLS}")


def ws_mb(rows: int, C: int, impl: str = "bitset") -> float:
    return ws_bytes(rows, C, impl) / 2**20
