"""Dense language-model stack."""
