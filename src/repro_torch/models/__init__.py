"""Model families (the dense transformer in this slice)."""
