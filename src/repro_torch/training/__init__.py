"""The port's training stack: AdamW (``optimizer``), checkpoints
(``checkpoint``), elastic restore onto a mesh (``elastic``) and the restartable
train loop (``train_loop``)."""
