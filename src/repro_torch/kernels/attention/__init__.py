"""K6 flash attention and K7 flash decode (plain versions and hand-written
kernels)."""
