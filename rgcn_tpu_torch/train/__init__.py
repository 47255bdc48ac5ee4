"""Training: ``optim.make_optimizer``, ``evaluate.accuracy`` and the
node-classification trainer (``node_classification``)."""
