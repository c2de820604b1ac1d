"""Data and view parallelism over `torch.distributed`: one process per GPU.

Port of `mvsformer_tpu/parallel/`. `mesh.py` lays the processes out on a
(data, view) grid and builds its process groups; `train/step.py`'s
`TrainStep`, `infer.make_infer_fn` and `infer.save_depth` take that
`Layout`; `dryrun.py` runs one training step over N CPU processes.
"""
