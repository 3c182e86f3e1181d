"""Parallelism strategies built on the collective substrate (port of
``ompi_tpu/parallel``).

The reference is a communication library with no DP/TP/PP/SP/EP engines;
SURVEY §2.6 maps each strategy to the comm primitives it is built from.
Each strategy here works on rank-major tensors, over one named axis of
a ``mesh_utils.Mesh`` of virtual ranks:

- dp: data parallelism (gradient allreduce through ``bucketer``'s
  buckets; ``overlap``'s tile-granular DP overlap session)
- tp: tensor parallelism (Megatron column/row sharding with
  allgather / reduce_scatter sequence transitions)
- sp: sequence/context parallelism (ring attention)
- pp: pipeline parallelism (a GPipe schedule over ring shifts)
- ep: expert parallelism (capacity-based MoE dispatch via all_to_all)
"""

from . import bucketer, dp, ep, mesh_utils, overlap, pp, sp, tp

__all__ = ["bucketer", "dp", "ep", "mesh_utils", "overlap", "pp", "sp",
           "tp"]
