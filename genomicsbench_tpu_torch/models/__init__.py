"""Neural models: the CTC basecaller (nn-base) and the Clair variant caller
(nn-variant)."""
