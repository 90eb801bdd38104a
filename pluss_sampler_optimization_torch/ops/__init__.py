"""Device ops of the port: the histogram primitives (histogram.py), the
fused classify+histogram kernel with its plain version (sampled_hist.py),
the pow2 histogram kernel with its plain version (pow2_hist.py) and the
device draw's threefry kernel with its plain version (threefry_draw.py)."""
