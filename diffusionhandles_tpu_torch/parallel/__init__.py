"""Batched editing: many rigid transforms of one inverted image in one
guided denoising (`parallel/batch.py`)."""
