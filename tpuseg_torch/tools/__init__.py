"""Research tools of the port (counterparts of ``tpuseg/tools/``):
``python -m tpuseg_torch.tools.trained_fidelity`` (the trained-weights
fidelity report) and ``python -m tpuseg_torch.tools.remat_mem`` (the
``--remat`` memory of one train step on the card)."""
