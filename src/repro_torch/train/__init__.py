"""Training on the card: AdamW (``optimizer``), the train step
(``train_loop``), checkpoints (``checkpoint``) and fault tolerance
(``ft``)."""
