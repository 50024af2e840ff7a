"""The component counts the port's grid-rule tests walk: every K of the
routes that hold all of K in a tile (1..512), and a sample of the large-K
routes' K up to 2048: around the multiples of their tiles of 128 and 256
rows of K, of 512, and their halves and thirds."""

WIDE_SAMPLE = (513, 520, 527, 528, 529, 600, 767, 768, 769, 1000, 1023, 1024, 1025,
               1500, 1536, 1537, 2000, 2047, 2048)
COVER_KS = tuple(range(1, 513)) + WIDE_SAMPLE
