"""Model families of the port.

- :mod:`llama`: the Llama-3 decoder (serving, LoRA and full training, the
  int8 base and KV caches);
- :mod:`bert`: the BERT encoder and its split (BASELINE.md config #5);
- :mod:`hf`: Hugging Face Llama checkpoints into :mod:`llama`'s tree;
- :mod:`lora`, :mod:`quant`: LoRA adapters and int8 weights;
- :mod:`logistic`, :mod:`resnet`: the FL baselines' models;
- :mod:`moe`: the mixture-of-experts layer, with expert parallelism;
- :mod:`convert`: trees carried across from the JAX package.

``llama``, ``bert``, ``resnet`` and ``moe`` each carry ``PARTITION_RULES`` for
:func:`rayfed_tpu_torch.parallel.sharding.shard_params_by_rules`.
"""
