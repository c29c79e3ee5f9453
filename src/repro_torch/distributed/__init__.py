"""Training state across failures and the wire, and the mesh layouts:
checkpoints in the JAX package's on-disk format, error-feedback int8
gradient compression, the FSDP × TP × EP × SP sharding rules as
``PartitionSpec`` trees and DTensor placements (``sharding``), and the
activation-sharding context that steers ``models/moe.py``'s
expert-parallel path (``act_sharding``)."""
