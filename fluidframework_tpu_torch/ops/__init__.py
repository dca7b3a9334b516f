"""Device state, plain merge-tree math, the Hopper kernel and the store."""
