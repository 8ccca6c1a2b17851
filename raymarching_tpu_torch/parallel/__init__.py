"""Ray-sharded rendering and fitting over ``torch.distributed``
(raymarching_tpu.parallel): ``distributed`` sets up the process group and
gathers frames, ``sharded`` splits a frame's rows over a device mesh.
Importing either module starts no process group."""
