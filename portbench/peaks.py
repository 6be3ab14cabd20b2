"""The card's peaks and the least time of the EI kernel K1.

NVIDIA H100 SXM5 (80 GB HBM3), at its 700 W limit:

- exp: 132 SMs x 16 special-function results per clock x 1.98 GHz, the
  boost clock.  Derived from the architecture, since the data sheet gives
  no transcendental rate; ``nvidia-smi``'s SM clock is recorded beside
  every traced run, because a card held below its boost clock reaches
  less;
- float32 outside the tensor cores: 67 TFLOP/s (data sheet);
- HBM3: 3.35 TB/s (data sheet).

K1 scores ``ei[c, i] = LSE_k(below terms) − LSE_k(above terms)`` for each
density column ``c`` and candidate ``i``.  Each live (candidate,
component) term needs one exp and 6 float32 operations besides it
(``z − μ``, ``· 1/σ``, a fused multiply-add for ``cb − t²/2`` counted as
2, the running max, the running sum); a column's live components are its
active observations in each set plus one prior component per set.  Bytes:
the candidates read and the scores written (4 bytes each), and three
float32 numbers per live component.  The least time of a launch is the
largest of the three.
"""

EXP_PER_S = 132 * 16 * 1.98e9
F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
FLOP_PER_TERM = 6


def k1_bound_s(terms, columns, components, n_cand):
    """``(seconds, "exp" | "flop" | "bytes")``: the least time of one K1
    launch over ``terms`` live terms, ``columns`` density columns and
    ``components`` live components in all, at ``n_cand`` candidates."""
    exp_s = terms / EXP_PER_S
    flop_s = terms * FLOP_PER_TERM / F32_FLOP_PER_S
    byte_s = 4 * (2 * columns * n_cand + 3 * components) / HBM_BYTES_PER_S
    return max((exp_s, "exp"), (flop_s, "flop"), (byte_s, "bytes"))
