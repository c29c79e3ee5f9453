"""Language-model layers of the port: every family's serving path
(``lm.forward`` for prefill, ``lm.decode_step`` for decode) on GQA or
MLA attention (``attention``), dense MLPs or the Mixture-of-Experts
layer (``moe``), Mamba2 / SSD blocks (``mamba2``; the ``ssm`` family)
and Zamba2's shared attention block over them (``hybrid``), with
prefill GQA attention through the flash-attention kernel when
``attention_impl="flash"``, and their training loss (``lm.loss_fn``,
the chunked cross-entropy of ``layers`` plus the MoE load-balance
term)."""
