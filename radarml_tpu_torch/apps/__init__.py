"""Application helpers of the port. Only the model-artifact half of
common_cli is ported; the command-line apps wait for ROADMAP A8."""
