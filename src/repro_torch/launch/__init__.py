"""Entry points of the model path: federated training (``train``),
serving (``serve``) and their steps (``steps.SiloSetup``,
``steps.ServeSetup``)."""
