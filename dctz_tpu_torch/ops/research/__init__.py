"""The one-pass DPK encode and decode (port of dctz_tpu/ops/research): kernel
L (fused_encode_dpk) and kernel M (fused_decode). Nothing in api calls
them."""
