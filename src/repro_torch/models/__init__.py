"""Language-model layers of the port: the dense family's serving path
(``lm.forward`` for prefill, ``lm.decode_step`` for decode) on GQA
attention, with prefill attention through the flash-attention kernel
when ``attention_impl="flash"``."""
