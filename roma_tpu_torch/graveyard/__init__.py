"""Ports of the JAX package's graveyard/ experiments: kernels that lost to
the routed paths on the TPU and stay as parity-tested records. Nothing on
the match or training path calls them."""
