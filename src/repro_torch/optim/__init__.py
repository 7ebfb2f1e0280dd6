"""AdamW with frozen-parameter masking (the counterpart of ``repro.optim``)."""
