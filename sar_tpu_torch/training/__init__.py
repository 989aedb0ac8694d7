"""Training-side modules of the port; so far the WER/CER metrics."""
