"""Data parallelism over processes, one process a card.

Counterpart of ``nerfdet_tpu/parallel/`` and of the ``--distributed``
set-up of the JAX tools: ``dist`` joins the process group and reduces
over it. The 2-D data x views sharding (``--mesh-views``) is not ported
(ROADMAP §1 item 1.4).
"""
