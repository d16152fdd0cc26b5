"""Low-level ops: windows, diamond folding, DCT-IV."""
