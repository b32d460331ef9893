"""Model families of the port: ``models.transformer`` and ``models.llama``
(serving and training), and the classifiers ``models.cnn`` (``init_cnn``,
``cnn_forward``, ``cnn_predict``) and ``models.mlp`` (``init_mlp``,
``mlp_predict``, ``sgd_step``)."""
