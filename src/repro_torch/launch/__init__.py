"""Launch: meshes, meta-device step inputs, the dry run's graph and cost
analysis, the dry run itself, and the training launcher (``--smoke``)."""
