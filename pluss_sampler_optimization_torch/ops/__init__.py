"""Device ops of the port: the exact pair reduction (histogram.py) and
the fused classify+histogram kernel with its plain version
(sampled_hist.py)."""
