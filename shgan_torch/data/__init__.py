"""Host-side helpers copied from ``shgan_tpu.data`` (no JAX there either)."""
