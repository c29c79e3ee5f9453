"""Training and step builders of the port: ``make_train_step``,
``make_eval_step``, ``make_prefill_step`` and ``make_serve_step``; AdamW
(``optimizer``), the seeded data stream (``data``) and the
fault-tolerant loop (``loop``)."""
