"""The five nets of the score path, as torch modules."""
