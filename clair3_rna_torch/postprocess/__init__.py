"""VCF post-processing: merge/sort, LowQual marking, REDIportal tagging."""
