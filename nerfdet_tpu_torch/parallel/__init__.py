"""Data parallelism over processes, one process a card.

Counterpart of ``nerfdet_tpu/parallel/`` and of the ``--distributed``
set-up of the JAX tools: ``dist`` joins the process group and reduces
over it; ``train2d`` and ``intra_scene`` shard each scene's views (and
rays) over a views group, the 2-D data x views sharding of
``--mesh-views``.
"""
