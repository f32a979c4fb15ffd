"""Host-side helpers of the port (counterpart of stpy_tpu/utils)."""
