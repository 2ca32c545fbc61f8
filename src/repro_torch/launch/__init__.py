"""Entry points of the model path: serving (``serve``) and its steps
(``steps.ServeSetup``)."""
