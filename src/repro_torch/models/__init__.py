"""Models of the port: the dense decoder LM (``transformer``), its layers,
parameter tables and the family facade (``model_zoo``)."""
