"""The repository's examples (examples/*.py) as the port's entry points, each
run as `python -m timemachine_torch.examples.<name>` with the JAX script's
arguments and defaults plus `--device` (default cuda). Each module's
`main(argv)` parses argv (None: the command line), prints the JAX script's
summary lines and writes its files."""
