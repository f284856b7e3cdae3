"""The plain reference: binder's answers worked out from the generated
zone and the acknowledged writes, with a DNS codec of its own.  It
imports nothing of the program under test."""
