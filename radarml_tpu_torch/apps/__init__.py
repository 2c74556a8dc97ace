"""Command-line apps of the port: `predict` and `serve`
(python -m radarml_tpu_torch.apps.<name>), and common_cli, their flags,
drivers and model artifacts."""
