"""The constraining workloads of the paper (App. C/D) in our EBNF format.

Each function returns grammar source text; ``load(name)`` parses it.
These drive Table 2 (GSM8K / CoNLL JSON schemas), Table 3 (JSON, JSON
w/schema, C, XML w/schema, fixed template) and the benchmarks.
"""
from __future__ import annotations

from repro_torch.core.grammar import Grammar, parse_grammar

_STRING = r'/"([^"\\]|\\(["\\\/bfnrt]|u[0-9a-fA-F]{4}))*"/'
_NUMBER = r'/(-)?([0-9]|[1-9][0-9]*)(\.[0-9]+)?([eE][-+]?[0-9]+)?/'


def json_grammar() -> str:
    """Basic JSON (App. C Listing 3)."""
    return rf'''
start: value
value: object | array | STRING | NUMBER | BOOL | NULL
object: "{{" (pair ("," pair)*)? "}}"
pair: STRING ":" value
array: "[" (value ("," value)*)? "]"
STRING: {_STRING}
NUMBER: {_NUMBER}
BOOL: /true|false/
NULL: "null"
WS: /[ \t\n\r]+/
%ignore WS
'''


def gsm8k_json_grammar() -> str:
    """Guided math reasoning schema (App. C Listing 4):
    {"thoughts": [{"step": s, "calculation": s, "result": n}, ...],
     "answer": n}
    """
    return rf'''
start: object
object: "{{" "\"thoughts\"" ":" "[" thought ("," thought)* "]" "," "\"answer\"" ":" NUMBER "}}"
thought: "{{" "\"step\"" ":" STRING "," "\"calculation\"" ":" STRING "," "\"result\"" ":" NUMBER "}}"
STRING: {_STRING}
NUMBER: {_NUMBER}
WS: /[ \t\n\r]+/
%ignore WS
'''


def conll_json_grammar() -> str:
    """CoNLL2003 NER output schema (App. D Listing 9)."""
    return rf'''
start: "{{" "\"entities\"" ":" "[" (entity ("," entity)*)? "]" "}}"
entity: "{{" "\"text\"" ":" STRING "," "\"type\"" ":" etype "}}"
etype: "\"PER\"" | "\"ORG\"" | "\"LOC\"" | "\"MISC\""
STRING: {_STRING}
WS: /[ \t\n\r]+/
%ignore WS
'''


def c_grammar() -> str:
    """Simple C subset (App. C Listing 5)."""
    return r'''
start: declaration+
declaration: datatype IDENT "(" parameter? ")" "{" statement* "}"
datatype: "int" | "float" | "char"
parameter: datatype IDENT
statement: datatype IDENT "=" expression ";"
         | datatype IDENT "[" expression "]" ("=" expression)? ";"
         | IDENT "=" expression ";"
         | IDENT "(" arglist? ")" ";"
         | "return" expression ";"
         | "while" "(" condition ")" "{" statement* "}"
         | "for" "(" forinit ";" condition ";" forupdate ")" "{" statement* "}"
         | "if" "(" condition ")" "{" statement* "}" ("else" "{" statement* "}")?
forinit: datatype IDENT "=" expression | IDENT "=" expression
forupdate: IDENT "=" expression
condition: expression relop expression
relop: "<=" | "<" | "==" | "!=" | ">=" | ">"
expression: term (addop term)*
addop: "+" | "-"
term: factor (mulop factor)*
mulop: "*" | "/"
factor: IDENT | NUMBER | "-" factor | IDENT "(" arglist? ")"
      | "(" expression ")" | IDENT "[" expression "]" | STRING
arglist: expression ("," expression)*
IDENT: /[a-zA-Z_][a-zA-Z_0-9]*/
NUMBER: /[0-9]+/
STRING: /"([^"\\]|\\(["\\\/bfnrt]|u[0-9a-fA-F]{4}))*"/
COMMENT: /\/\/[^\n]*\n/
WS: /[ \t\n]+/
%ignore WS
%ignore COMMENT
'''


def xml_schema_grammar() -> str:
    """XML person schema (App. C Listing 6)."""
    return r'''
start: person
person: "<person>" nameattr ageattr jobattr friends? "</person>"
nameattr: "<name>" TEXT "</name>"
ageattr: "<age>" TEXT "</age>"
jobattr: "<job>" jobtitle jobsalary "</job>"
jobtitle: "<title>" TEXT "</title>"
jobsalary: "<salary>" TEXT "</salary>"
friends: "<friends>" person+ "</friends>"
TEXT: /[^<]+/
WS: /[ \t\n]+/
%ignore WS
'''


def rpg_template_grammar() -> str:
    """Fixed-template RPG character sheet (App. C Listing 7) as a CFG —
    the schema pins field order and some literal values."""
    return rf'''
start: "{{" idp "," descp "," namep "," agep "," armorp "," weaponp "," classp "," mantrap "," strengthp "," itemsp "}}"
idp: "\"id\"" ":" NUMBER
descp: "\"description\"" ":" "\"A nimble fighter\""
namep: "\"name\"" ":" STRING
agep: "\"age\"" ":" NUMBER
armorp: "\"armor\"" ":" ("\"leather\"" | "\"chainmail\"" | "\"plate\"")
weaponp: "\"weapon\"" ":" ("\"sword\"" | "\"axe\"" | "\"bow\"")
classp: "\"class\"" ":" STRING
mantrap: "\"mantra\"" ":" STRING
strengthp: "\"strength\"" ":" NUMBER
itemsp: "\"items\"" ":" "[" STRING "," STRING "," STRING "]"
STRING: /"[^\n\r"]+"/
NUMBER: /[0-9]+/
WS: /[ \t\n]+/
%ignore WS
'''


def arithmetic_grammar() -> str:
    """The running example of Fig. 3: E -> int | (E) | E + E."""
    return r'''
start: e
e: INT | "(" e ")" | e "+" e
INT: /[1-9][0-9]*|0+/
WS: /[ ]+/
%ignore WS
'''


GRAMMARS = {
    "json": json_grammar,
    "json_gsm8k": gsm8k_json_grammar,
    "json_conll": conll_json_grammar,
    "c": c_grammar,
    "xml_schema": xml_schema_grammar,
    "template_rpg": rpg_template_grammar,
    "arith": arithmetic_grammar,
}


def load(name: str) -> Grammar:
    return parse_grammar(GRAMMARS[name]())
