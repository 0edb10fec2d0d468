"""The staged LM (dense GQA training surface) and its layers."""
