"""Training: ``optim.make_optimizer``, ``evaluate`` (accuracy, ranking
metrics), the node-classification trainer (``node_classification``) and
the link-prediction trainer (``link_prediction``, with ``samplers`` and
``negative``)."""
