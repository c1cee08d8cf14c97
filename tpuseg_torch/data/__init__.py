"""Frame data for the port: the Cityscapes palette and the shapes world."""
