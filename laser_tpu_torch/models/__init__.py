"""Model families of the port: ``models.transformer`` and ``models.llama``."""
