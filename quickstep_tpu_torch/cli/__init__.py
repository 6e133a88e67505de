# Copied from quickstep_tpu/cli/__init__.py; only the package name in imports differs.
