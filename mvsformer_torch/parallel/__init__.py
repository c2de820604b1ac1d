"""Data, view and depth parallelism over `torch.distributed`: one process
per GPU.

Port of `mvsformer_tpu/parallel/`. `mesh.py` lays the processes out on a
(data, view, depth) grid and builds its process groups; `depth.py` runs
the cost regularisers over slabs of the depth hypotheses (eval);
`train/step.py`'s `TrainStep`, `infer.make_infer_fn` and
`infer.save_depth` take that `Layout`; `dryrun.py` runs one training step
over N processes.
"""
