"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, at the full power limit of 700 W).  A roofline share is stated
against these, with the card's power limit printed beside it."""

HBM_BYTES_PER_S = 3.35e12  # 80 GB of HBM3 at 3.35 TB/s
