"""Training: the optimizer (`optim.py`), one step (`step.py`), the
trainer's epoch loop with validation and checkpoints (`trainer.py`,
`checkpoint.py`, `meters.py`) and the command line (`__main__.py`)."""
