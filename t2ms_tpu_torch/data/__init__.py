"""The T2S data path: CSV corpora, length-bucketed batches, prefetch."""
