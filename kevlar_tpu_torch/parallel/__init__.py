"""Multi-device execution: sharded sketches over a mesh of torch devices.

Counterpart of ``kevlar_tpu.parallel``.  The reference scales with k-mer
*banding* — N serial passes over the data, each counting 1/N of the hash
space, merged by ``unband``.  Here, as in ``kevlar_tpu``, the band
dimension is a mesh axis instead: the Count-Min sketch is
hash-range-sharded across devices ('shard' axis), read batches are
data-parallel ('data' axis), counts sum over 'data' and lookups take the
minimum over 'shard' — one pass, collectives instead of N-fold re-runs.
One process drives the whole mesh (:mod:`.mesh`, :mod:`.collectives`), or,
after :func:`init_distributed`, each of several ranks drives its own cells
of one mesh and the collectives cross ranks through ``torch.distributed``.
"""

from kevlar_tpu_torch.parallel.mesh import (Mesh, device_grid,
                                            init_distributed, make_mesh)
from kevlar_tpu_torch.parallel.sharded import (ShardedSketch,
                                               sharded_novel_screen)
