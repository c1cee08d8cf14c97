"""Data for the port: the Cityscapes lists and palette, paired transforms,
batching with device prefetch, and the shapes world."""
