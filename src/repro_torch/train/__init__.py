"""LM training: AdamW with f32 master weights (optimizer.py), the train
step and the data-parallel step over the device grid (train_step.py),
and int8 gradient compression with error feedback (grad_compress.py) --
the port of repro/train/ for one device or logical devices on one card.
"""
