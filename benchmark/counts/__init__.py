"""Work counts of the program's layers, from the sizes a pass needs, for
the roofline shares of ``metrics/``; and the card's peaks."""

# NVIDIA H100 SXM (80 GB HBM3) data sheet, dense, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
