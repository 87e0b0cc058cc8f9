"""Scale-out: device meshes, the sharded channelizer and resampler, the
receive pipeline over a mesh, and multi-process runs over
``torch.distributed`` (port of ``tsl_sdr_tpu/parallel``).

* ``channels`` axis: each shard owns a slice of the channel bank (its own
  K1 constants); the wideband input is the same for every shard of a time
  row.
* ``time`` axis: a block's samples split into contiguous spans; K1's
  history and look-back rows cross span boundaries as a halo of input rows
  from the span before.
"""

from tsl_sdr_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
