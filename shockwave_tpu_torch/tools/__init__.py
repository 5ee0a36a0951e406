"""Measurement tools of the shockwave_tpu PyTorch port."""
