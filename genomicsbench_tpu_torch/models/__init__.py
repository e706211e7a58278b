"""Neural models: the CTC basecaller (nn-base)."""
