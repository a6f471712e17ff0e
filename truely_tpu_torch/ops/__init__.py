"""Device ops: the four kernels beside their plain versions, and the small tensor ops around them."""
