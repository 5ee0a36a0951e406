"""Part of the shockwave_tpu PyTorch port."""
