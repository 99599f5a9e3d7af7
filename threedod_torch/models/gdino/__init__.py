"""GroundingDINO (Swin-T + BERT-base, deformable encoder and decoder), the
text-prompted detector of the ground-segmentation asset pipeline
(counterpart of ``threedod/models/gdino``)."""
