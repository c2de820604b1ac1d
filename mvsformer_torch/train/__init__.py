"""Training: the optimizer (`optim.py`) and one training step (`step.py`)."""
