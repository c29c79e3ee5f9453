"""Training state across failures and the wire: checkpoints in the JAX
package's on-disk format and error-feedback int8 gradient compression.
The reference's mesh sharding (``sharding``, ``act_sharding``) has no
counterpart in the port yet (ROADMAP queue 1 item 10)."""
