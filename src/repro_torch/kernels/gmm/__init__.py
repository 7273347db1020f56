"""K5: the GMM background update (plain version and hand-written kernel)."""
