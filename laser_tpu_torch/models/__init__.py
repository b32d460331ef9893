"""Model families of the port: ``models.transformer``."""
