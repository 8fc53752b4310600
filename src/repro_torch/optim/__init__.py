"""The port's optimisers: AdamW with float32 moments (``adamw``) and
PowerSGD gradient compression with error feedback (``grad_compress``)."""
