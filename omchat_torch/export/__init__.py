"""The ``trust_remote_code`` bundle: standalone torch / transformers code
files (``hf_code/``) that ``checkpoint.save.export_hf_bundle`` copies beside
the exported weights.  Nothing here imports the rest of the port."""
